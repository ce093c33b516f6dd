"""``anneal.first_level_overhead_s`` (s): level 0's eager warm-up step plus
its CUDA graph's capture and instantiation, from the program's own
``separation.graphs.Record`` (host clock). A separation pays it once: the
process's first capture at the cell's shapes, beside the nine levels that
``anneal.level_overhead_s`` reads. Nothing to read where level 0 captured
no graph."""


def read(ctx):
    caps = [c for c in ctx.record.captures if c.level == 0]
    if not caps:
        return None
    return caps[0].warmup_s + caps[0].capture_s
