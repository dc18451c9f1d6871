"""Host ms a sampling step waits for the device: the time of the
`cudaStreamSynchronize`, `cudaDeviceSynchronize` and
`cudaEventSynchronize` calls that begin inside the program's
`sample.step` span, per traced step. Nothing where the program has no
such span. Moves `sample_mol_per_s`."""
from portbench import spans


def read(rec):
    if rec.get("kind") != "sample" or not rec.get("host"):
        return None
    steps = spans.named(rec["host"], "sample.step")
    if not steps:
        return None
    return sum(spans.inside_us(rec["host"], steps, spans.SYNC)) \
        / len(steps) / 1e3
