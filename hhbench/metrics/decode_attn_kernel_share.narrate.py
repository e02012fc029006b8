"""``models/gpt2.py`` (decode attention over the self and cross caches):
percent of the traced batch's decode attention calls that the
hand-written kernel made, the counter ``hh.narrate.decode_attn_kernel_calls``
over ``hh.narrate.decode_steps`` times the attention calls a step (every
block's self-attention and every cross block's, from ``run.cfg["lm"]``). A
program without that counter (one that attends through SDPA) reads
nothing."""

from hhbench.metrics._program import table


def read(run):
    t = table(run) or {}
    calls, steps = t.get("hh.narrate.decode_attn_kernel_calls"), t.get("hh.narrate.decode_steps")
    if calls is None or steps is None or not steps["count"]:
        return None
    lm = run.cfg["lm"]
    every = lm["cross_attn_every"]
    per_step = lm["n_layer"] + sum(1 for i in range(lm["n_layer"]) if every and i % every == 0)
    return 100.0 * calls["count"] / (steps["count"] * per_step)
