"""The benchmark's CPU tests' tiny sizes of the narrator cell
(``narrate4f336.b64x10``), added to ``tiny.py``'s tables beside those of
the other cells: its traffic's parameters in ``tiny.PARAMS``, and in
``tiny.tiny_cfg`` the widths of a configuration with a language model
(one with an ``lm`` group): ``tiny.VISUAL``'s tower, 8 latents of width
64, a 4-block GPT-2 of width 64 with 4 heads and a 97-word vocabulary, 3
sequences of 6 positions."""

import copy

import tiny

NARRATE_PARAMS = {"batch": 2, "pool": 2, "warmup_s": 0, "warmup_min_s": 0, "keep_batches": 3, "check_batches": 2}
POOL = {"num_queries": 8, "heads": 4, "dim_head": 16}
LM = {"vocab_size": 97, "n_positions": 16, "n_embd": 64, "n_layer": 4, "n_head": 4, "n_inner": 256}
GENERATION = {"num_return_sequences": 3, "max_text_length": 6, "bos_token_id": 96, "eos_token_id": 96}

tiny.PARAMS.setdefault("narrate_b64x10", NARRATE_PARAMS)
_tiny_cfg = tiny.tiny_cfg


def _narrator_tiny_cfg(cfg: dict, frames: int = 4) -> dict:
    if "lm" not in cfg:
        return _tiny_cfg(cfg, frames)
    out = copy.deepcopy(cfg)
    out["visual"] = dict(tiny.VISUAL, num_frames=frames)
    out["pool"].update(POOL, context_dim=tiny.VISUAL["width"])
    out["lm"].update(LM)
    out["generation"].update(GENERATION)
    return out


tiny.tiny_cfg = _narrator_tiny_cfg
