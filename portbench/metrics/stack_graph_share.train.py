"""Share of the layer recomputes in `LayerStackFn.backward` that ran as a
replay of the program's captured CUDA graph, %: the program's counter
`STACK_GRAPH` (`ops/layer_stack.py`), replays over replays and eager
recomputes, over the whole run. Nothing where the program has no such
counter or no recompute ran. Moves `train_graphs_per_s`."""


def read(rec):
    if rec.get("kind") != "train":
        return None
    from phoregen_tpu_torch.ops import layer_stack
    counts = getattr(layer_stack, "STACK_GRAPH", None)
    if not counts:
        return None
    n = counts["replays"] + counts["eager"]
    if not n:
        return None
    return 100.0 * counts["replays"] / n
