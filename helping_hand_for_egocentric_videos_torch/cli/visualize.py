"""CLI: render predicted hand/object box trajectories onto frames.

Counterpart of ``helping_hand_for_egocentric_videos_tpu/cli/visualize.py``
(the reference's demo/visualize_box.py): runs the model on a clip and saves
``boxes.png``, a row of frames with the hand boxes (queries 0:2, red) and
the object boxes (green) drawn on each; with ``--attn`` also
``cross_attn.png``, the last decoder layer's cross-attention of each query
over the T x N patch grid (a row a query, a tile a frame), each query's map
scaled to its maximum and enlarged 8x.

Example:
    python -m helping_hand_for_egocentric_videos_torch.cli.visualize \\
        --clip clip.mp4.npy --backbone_ckpt lavila_large.pth \\
        --decoder_ckpt nq12.pth.tar --out_dir vis --attn
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.nn.functional as F

from . import common


def draw_boxes(frame_u8: np.ndarray, boxes_xyxy: np.ndarray, color=(0, 255, 0)):
    """Draw pixel-space xyxy boxes on a (H, W, 3) uint8 frame (PIL)."""
    from PIL import Image, ImageDraw

    img = Image.fromarray(frame_u8)
    d = ImageDraw.Draw(img)
    for b in boxes_xyxy:
        if b[2] > b[0] and b[3] > b[1]:
            d.rectangle([float(b[0]), float(b[1]), float(b[2]), float(b[3])], outline=color, width=2)
    return np.asarray(img)


def display_frames(frames_u8: np.ndarray, res: int) -> np.ndarray:
    """(T, H, W, 3) uint8 -> (T, res, res, 3) uint8: an antialiased
    bilinear resize (as ``jax.image.resize`` does), truncated to uint8."""
    x = torch.from_numpy(np.asarray(frames_u8)).float().permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(res, res), mode="bilinear", align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1).numpy().astype(np.uint8)


def cross_attention_maps(model, frames_u8: np.ndarray, dtype=torch.bfloat16) -> torch.Tensor:
    """The last decoder layer's head-averaged cross-attention of one clip:
    (T, H, W, 3) uint8 -> (Q, T*N) f32 on the model's device. The backbone
    runs through ``encode_image`` in ``dtype`` on ``model.backbone``."""
    from ..models.lavila import encode_image
    from ..models.obj_decoder import decoder_forward
    from ..ops.preprocess import resize_normalize

    lcfg = model.lavila_cfg
    t, n = frames_u8.shape[0], lcfg.visual.patches_per_frame
    with torch.inference_mode():
        video = resize_normalize(torch.as_tensor(np.asarray(frames_u8)[None], device=model.device), model.input_res)
        _, fmap = encode_image(model.backbone, lcfg, video, dtype=dtype)
        grid = fmap[:, 1:, :].reshape(1, t, n, -1)
        out = decoder_forward(model.decoder, model.dec_cfg, grid, return_attn=True)
        return out.cross_attn[-1, 0].float()


def main(argv=None):
    """-> {"boxes": (T, Q, 4) pixel xyxy, "boxes_png": path, "cross_attn":
    (Q, T*N) or None, "cross_attn_png": path or None}."""
    p = argparse.ArgumentParser(description=__doc__)
    common.add_eval_args(p)
    p.add_argument("--clip", required=True, help="video path (mp4 or .npy clip)")
    p.add_argument("--start", type=float, default=0.0)
    p.add_argument("--end", type=float, default=2.0)
    p.add_argument("--out_dir", default="vis")
    p.add_argument(
        "--attn", action="store_true",
        help="also save per-query cross-attention heatmaps (plot_attn_map parity)",
    )
    p.set_defaults(num_frames=4, pred_traj=True)
    args = p.parse_args(argv)
    common.print_env(args.device)

    from PIL import Image

    from ..data.video import read_clip_chunked
    from ..ops.boxes import box_cxcywh_to_xyxy

    model, _, _ = common.build_eval_model(args)
    frames, _ = read_clip_chunked(args.clip, args.start, args.end, clip_length=args.num_frames)
    _, pred_boxes = model.embed_video(frames[None])
    t = args.num_frames
    res = model.input_res
    boxes = box_cxcywh_to_xyxy(torch.from_numpy(pred_boxes)).numpy() * res
    boxes = boxes.reshape(t, -1, 4) if boxes.shape[0] == t else np.repeat(boxes, t, axis=0)

    os.makedirs(args.out_dir, exist_ok=True)
    vis_frames = display_frames(frames, res)
    rows = []
    for f in range(t):
        hands = draw_boxes(vis_frames[f], boxes[f, :2], color=(255, 0, 0))
        objs = draw_boxes(hands, boxes[f, 2:-1] if boxes.shape[1] > 3 else boxes[f, 2:], color=(0, 255, 0))
        rows.append(objs)
    grid = np.concatenate(rows, axis=1)
    out_path = os.path.join(args.out_dir, "boxes.png")
    Image.fromarray(grid).save(out_path)
    print(f"saved {out_path}")
    result = {"boxes": boxes, "boxes_png": out_path, "cross_attn": None, "cross_attn_png": None}

    if args.attn:
        attn = cross_attention_maps(model, frames).cpu().numpy()  # (Q, T*N)
        n = model.lavila_cfg.visual.patches_per_frame
        side = int(n**0.5)
        maps = attn.reshape(-1, t, side, side)
        maps = maps / (maps.max(axis=(1, 2, 3), keepdims=True) + 1e-8)
        q_rows = []
        for qi in range(maps.shape[0]):
            heat = (maps[qi] * 255).astype(np.uint8)  # (T, side, side)
            q_rows.append(np.concatenate(list(heat), axis=1))
        attn_img = np.concatenate(q_rows, axis=0)
        attn_path = os.path.join(args.out_dir, "cross_attn.png")
        Image.fromarray(attn_img).resize(
            (attn_img.shape[1] * 8, attn_img.shape[0] * 8), Image.NEAREST
        ).save(attn_path)
        print(f"saved {attn_path}")
        result.update(cross_attn=attn, cross_attn_png=attn_path)
    return result


if __name__ == "__main__":
    main()
