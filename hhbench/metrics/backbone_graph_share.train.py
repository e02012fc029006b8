"""``train/step.py`` (the host's launch path; ``train/backbone_graph.py``):
percent of the traced steps' backbone calls (``hh.step.backbone``) served
by a CUDA graph's replay (``hh.step.backbone.replay``). None where the
program's catalogue has no such span (an older program) or no backbone
call was traced."""

from hhbench.metrics._program import table


def read(run):
    spans = table(run)
    if spans is None:
        return None
    from helping_hand_for_egocentric_videos_torch.utils import profiling

    calls = spans.get("hh.step.backbone")
    if "hh.step.backbone.replay" not in getattr(profiling, "SPANS", {}) or not calls or not calls["count"]:
        return None
    replays = spans.get("hh.step.backbone.replay", {"count": 0})
    return 100.0 * replays["count"] / calls["count"]
