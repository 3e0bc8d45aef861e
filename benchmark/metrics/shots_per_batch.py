"""Mean screenshots a parse_batch call carried over the window (the
harness counts each call of the batcher's process function)."""


def read(run):
    sizes = [b["size"] for b in run["batches"]]
    return sum(sizes) / len(sizes) if sizes else None
