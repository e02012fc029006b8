"""Offline embedding from a chunked clip store, as ``extract_features``
and ``test_epic`` run it.

Set-up writes a store of ``chunks`` uint8 ``.npy`` chunks of
``chunk_frames`` frames of ``frame_hw`` made from the seed under
``TMPDIR``; clip ``i`` is ``frames`` frames of chunk ``i % chunks`` from
second ``(0.37 i) mod 2`` to one second later, read by the program's
``read_clip_chunked``. The program's ``PrefetchLoader`` (``threads``
decode threads, ``depth`` batches ahead) collates ``batch`` clips, which
``pinned_put`` copies a batch ahead of ``EvalModel.preprocess_video`` and
``EvalModel.embed_clips``. The window issues batches until ``--seconds``
have passed and then waits for the device: ``embed_clips_per_s`` is every
clip over all that time.

``correct``: as each batch of the window reaches the decoder
(``decoder_forward``, called by ``EvalModel.embed_clips``), the patch grid
of one of its clips, drawn from the seed, is kept on the device. Once the
window has closed, ``check_clips`` of those clips, drawn from the seed, go
through the reference from the raw store: ``embed_rel_gap`` (the mean over
the sample of each embedding's relative L2 gap) and ``vis_gap`` (the same
mean of the kept patch grids' relative gap to the reference tower's); and
the reference's decoder and ``obj_proj`` on the kept grids: ``head_gap``
(the same mean of the embeddings' gap), which no rounding of the bf16
tower blurs. ``boxes_gap`` (the mean over the sample of each clip's
largest absolute gap of a predicted box coordinate) is printed beside
them, with no limit.
"""

from __future__ import annotations

import os
import shutil

import numpy as np

from .. import common, weights
from ..harness import Result, Run

FPS = 30.0


def clip_start(i: int) -> float:
    return (0.37 * i) % 2.0


def write_store(root: str, p: dict, seed: int, device) -> list:
    import torch

    gen = torch.Generator(device=device).manual_seed(common.torch_seed(seed, 1))
    h, w = p["frame_hw"]
    frames = torch.randint(0, 256, (p["chunks"], p["chunk_frames"], h, w, 3), generator=gen, device=device,
                           dtype=torch.uint8).cpu().numpy()
    paths = []
    for c in range(p["chunks"]):
        np.save(os.path.join(root, f"{c}.mp4.npy"), frames[c])
        paths.append(os.path.join(root, f"{c}.mp4"))
    return paths


class StoreClips:
    """Clip ``i`` of the store through the program's chunked reader."""

    def __init__(self, paths, n: int, frames: int):
        self.paths, self.n, self.frames = paths, n, frames

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        from helping_hand_for_egocentric_videos_torch.data.video import read_clip_chunked

        s = clip_start(i)
        clip, _ = read_clip_chunked(self.paths[i % len(self.paths)], s, s + 1.0, clip_length=self.frames, fps=FPS)
        return {"video": clip, "index": np.int64(i)}


def reference_frame_ids(i: int, frames: int) -> list:
    """LaViLa's rounded segment sampling without jitter over the clip's
    frames (start frame round(start * fps), one second of frames)."""
    start = int(np.round(clip_start(i) * FPS))
    end = start + max(int(1.0 * FPS), frames)
    seg = float(end - start - 1) / frames
    ids = []
    for k in range(frames):
        a = int(np.round(seg * k) + start)
        b = min(int(np.round(seg * (k + 1)) + start), end)
        ids.append((a + b) // 2)
    return ids


def embed_compare(emb, boxes, grids, video, cfg: dict, wb: dict, wd: dict, device, block: int) -> dict:
    """The compared numbers of an embedding cell (module docstring): the
    program's embeddings and boxes of the uint8 clips ``video`` on the
    host, and the patch grids its tower handed its decoder (None: not
    read), against the reference."""
    import torch

    from ..reference import full_f32, model as ref, preprocess

    with torch.no_grad(), full_f32():
        x = preprocess.resize_normalize(torch.as_tensor(video, device=device), cfg["visual"]["img_size"])
        r_emb, r_boxes, r_grid = ref.embed_clips(wb, wd, cfg, x, block=block, keep_grid=grids is not None)
        n = emb.shape[0]
        out = common.embed_gaps(emb, r_emb.cpu(), boxes.reshape(n, -1), r_boxes.cpu().reshape(n, -1))
        if grids is not None:
            out["vis_gap"] = common.mean_row_gap(grids.float(), r_grid)
            del r_grid
            h_emb = torch.cat([ref.embed_head(wd, cfg, grids[lo:lo + block].to(device).float())[0]
                               for lo in range(0, grids.shape[0], block)])
            out["head_gap"] = common.mean_row_gap(emb, h_emb.cpu())
    return out


def run(run: Run) -> Result:
    import torch
    import helping_hand_for_egocentric_videos_torch.train.evaluate as evaluate_module
    from helping_hand_for_egocentric_videos_torch.data.loader import PrefetchLoader, ShardedSampler, pinned_put
    from helping_hand_for_egocentric_videos_torch.train import EvalModel

    p, cfg, dev = run.params, run.cfg, run.device
    b, frames = p["batch"], cfg["visual"]["num_frames"]
    root = common.scratch_dir(f"store-{run.cell.name}")
    paths = write_store(root, p, run.seed, dev)
    loader = PrefetchLoader(StoreClips(paths, p["dataset_clips"], frames),
                            ShardedSampler(p["dataset_clips"], b, shuffle=False, drop_last=True),
                            num_threads=p["threads"], depth=p["depth"])
    it = iter(loader)
    lcfg, dcfg = weights.port_configs(cfg)
    backbone, decoder = weights.port_models(cfg, weights.make(cfg, "backbone", run.seed, dev),
                                            weights.make(cfg, "decoder", run.seed, dev), dev)
    int8, dtype = common.tower_type(cfg)
    model = EvalModel(backbone, lcfg, decoder, dcfg, None, input_res=cfg["visual"]["img_size"], dtype=dtype,
                      device=dev, int8=int8)
    del backbone, decoder

    def fetch():
        with run.spans("hhb.data_wait"):
            host = next(it)
        with run.spans("hhb.pinned_put"):
            return pinned_put(host, dev)

    def forward(batch):
        with run.spans("hhb.embed_clips"):
            emb, boxes = model.embed_clips(model.preprocess_video(batch["video"]))
        return batch["index"], emb, boxes

    pick_row = common.rng(run.seed, 3)
    kept = []  # (row, its patch grid) of each batch of the window

    def keep(out, *args, **kwargs):
        grid = args[2] if len(args) > 2 else kwargs["features"]
        r = int(pick_row.integers(grid.shape[0]))
        kept.append((r, grid[r].detach().clone()))

    sync = torch.cuda.synchronize if torch.device(dev).type == "cuda" else (lambda: None)
    with torch.inference_mode():
        cur = fetch()
        forward(cur[0])  # warm-up at the window's one shape
        sync()
        outs, done = [], 0
        with common.tapped(evaluate_module, "decoder_forward", keep):
            run.open_window()
            while True:
                outs.append(forward(cur[0]))
                done += b
                cur = fetch()
                if run.elapsed() >= run.seconds:
                    break
            sync()
            run.close_window(done)
        with run.traced(items=2 * b, steps=2):
            for _ in range(2):
                forward(cur[0])
                cur = fetch()
        run.read_memory()
    it.close()
    del model, cur
    if len(kept) != len(outs):
        raise RuntimeError(f"the decoder saw {len(kept)} of the window's {len(outs)} batches")
    pick = np.sort(common.rng(run.seed, 2).choice(len(outs), size=min(p["check_clips"], len(outs)), replace=False))
    ids = [int(outs[k][0][kept[k][0]]) for k in pick]
    emb = torch.stack([outs[k][1][kept[k][0]] for k in pick]).float().cpu()
    boxes = torch.stack([outs[k][2][kept[k][0]] for k in pick]).float().cpu()
    grids = torch.stack([kept[k][1] for k in pick]).cpu()
    del outs, kept
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()

    def check() -> dict:
        try:
            chunks = [np.load(path + ".npy", mmap_mode="r") for path in paths]
            video = np.stack([chunks[i % len(chunks)][reference_frame_ids(i, frames)] for i in ids])
            return embed_compare(emb, boxes, grids, video, cfg, weights.make(cfg, "backbone", run.seed, dev),
                                 weights.make(cfg, "decoder", run.seed, dev), dev, p.get("check_block", 4))
        finally:
            shutil.rmtree(root, ignore_errors=True)

    return Result(e2e={"embed_clips_per_s": done / run.window_s}, attempted=done, failed=0, check=check)
