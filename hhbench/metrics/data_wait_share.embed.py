"""``data/`` (``PrefetchLoader``, ``read_clip_chunked``): percent of the
window the forward loop spent blocked in ``next()`` of the loader's
iterator, on the harness's host clock (span ``hhb.data_wait``)."""


def read(run):
    if not run.window_s or "hhb.data_wait" not in run.spans.count:
        return None
    return 100.0 * run.spans.seconds["hhb.data_wait"] / run.window_s
