"""95th percentile of the sampling step's time, ms: the intervals between
CUDA events recorded after each step's enqueue over the traced run's
window (leaving out the steps under the profiler). Moves
`sample_mol_per_s`."""
import statistics


def read(rec):
    iv = rec.get("step_ms") if rec.get("kind") == "sample" else None
    if not iv or len(iv) < 20:
        return None
    return statistics.quantiles(iv, n=20)[18]
