"""Environment diagnosis: what will and won't work on this host.

Counterpart of ``helping_hand_for_egocentric_videos_tpu/cli/doctor.py``.
Probes every gated dependency the port uses — the CUDA device (its names,
and a tiny bf16 product on it, under a timeout, so a hung device
reports ``no response`` instead of blocking forever), the CUDA kernels'
build directory (``ops/_build.py``: its libraries, and whether ``nvcc``
is found), the native C++ decode stage, the optional python decode
backends and the vendored BPE vocab — and prints one JSON report. Exit
code 0 iff the compute path is usable (devices reachable + the product
executes + the vocab is there). ``--device cpu`` diagnoses the CPU
instead; without a card, the default ``cuda`` reports that and exits 1.

The reference has no equivalent; its failures surface as import errors
or NCCL timeouts deep inside the harnesses.

Usage:
    python -m helping_hand_for_egocentric_videos_torch.cli.doctor [--timeout 60] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading

from ..ops._build import BUILD_DIR

# the md5 sidecar of released_weights_report, in the checkout's build/
MD5_CACHE = BUILD_DIR.parent / "doctor_md5.json"


def _with_timeout(fn, seconds: float):
    """Run fn() on a daemon thread; (ok, value-or-error-string).

    A hung device can block its calls indefinitely — a daemon thread
    lets the doctor report and exit anyway.
    """
    out: dict = {}

    def run():
        try:
            out["value"] = fn()
        except Exception as e:  # noqa: BLE001 - diagnosis, not control flow
            out["error"] = f"{type(e).__name__}: {e}"

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        return False, f"no response within {seconds:.0f}s (device hung?)"
    if "error" in out:
        return False, out["error"]
    return True, out.get("value")


def _devices(device) -> list[str]:
    import torch

    if device.type == "cpu":
        return ["cpu"]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to diagnose the CPU")
    return [f"cuda:{i} {torch.cuda.get_device_name(i)}" for i in range(torch.cuda.device_count())]


def _smoke(device) -> str:
    """A (128, 128) bf16 product of ones on ``device``: every entry is 128."""
    import torch

    x = torch.ones((128, 128), dtype=torch.bfloat16, device=device)
    total = float((x @ x).float().sum())
    return "ok" if total == 128.0**3 else f"wrong result: {total}"


def _kernel_build() -> dict:
    """The CUDA kernels' build directory: its libraries, and nvcc."""
    from ..ops import _build

    try:
        nvcc = _build._nvcc()
    except RuntimeError:
        nvcc = None
    libs = sorted(p.name for p in _build.BUILD_DIR.glob("lib*.so")) if _build.BUILD_DIR.is_dir() else []
    return {"dir": str(_build.BUILD_DIR), "entries": len(libs), "libraries": libs, "nvcc": nvcc}


def collect(timeout: float = 60.0, device: str = "cuda") -> dict:
    import torch

    report: dict = {"python": sys.version.split()[0], "torch": torch.__version__, "cuda": torch.version.cuda,
                    "device": device}
    dev = torch.device(device)
    ok, val = _with_timeout(lambda: _devices(dev), timeout)
    report["devices"] = val if ok else None
    report["devices_error"] = None if ok else val

    if ok:
        report["device_smoke"] = _with_timeout(lambda: _smoke(dev), timeout)[1]
    else:
        report["device_smoke"] = "skipped (no devices)"

    # ---- host decode stage
    from ..data import native, video

    try:
        native.get_lib()
        report["native_stage"] = "ok"
    except native.NativeUnavailable as e:
        report["native_stage"] = str(e)
    report["ffmpeg"] = bool(native.has_ffmpeg())
    report["decode_backends"] = video.available_backends()

    # ---- assets / builds
    from ..data import tokenizer as tok_mod

    report["bpe_vocab"] = os.path.isfile(tok_mod.DEFAULT_BPE_PATH)
    report["kernel_build"] = _kernel_build()

    report["released_weights"] = released_weights_report()

    report["usable"] = bool(
        report["devices"] and report["device_smoke"] == "ok" and report["bpe_vocab"]
    )
    return report


# The released artifacts the accuracy-parity gate needs (reference
# README.md:16,47). The LaviLa file name embeds its own md5 prefix
# (…md5sum_c89337.pth), verified on discovery; the Oxford tarballs
# publish no hash, so the md5 of whatever is found is recorded for
# provenance (parity_check separately stamps sha256 into PARITY_REPORT).
RELEASED_WEIGHTS = [
    {
        "file": "clip_openai_timesformer_large.narrator_rephraser.ep_0003."
        "md5sum_c89337.pth",
        "role": "frozen LaviLa TSF-L dual encoder (--backbone_ckpt)",
        "md5_prefix": "c89337",
        "source": "dl.fbaipublicfiles.com/lavila/checkpoints/dual_encoders/"
        "ego4d/",
    },
    {
        "file": "helping-hand-ckpt-nq12.pth.tar",
        "role": "trained decoder, 12 object queries (--decoder_ckpt)",
        "md5_prefix": None,
        "source": "robots.ox.ac.uk/~czhang/",
    },
    {
        "file": "helping-hand-ckpt-nq4.pth.tar",
        "role": "optional: 4-query decoder used for box extraction",
        "md5_prefix": None,
        "source": "robots.ox.ac.uk/~czhang/",
    },
]

def _weight_search_dirs() -> list[str]:
    return [
        os.path.expanduser(d)
        for d in (
            os.environ.get("HH_WEIGHTS", ""),
            os.environ.get("HH_CLIP_CACHE", ""),
            "weights",
            "~/.cache/clip",
            "~/.cache/lavila",
            "~/.cache/helping_hand",
        )
        if d
    ]


def _md5_cached(path: str) -> str:
    """md5 of a (possibly multi-GB) file, memoized by (size, mtime) in a
    sidecar in the checkout's ``build/`` so repeat doctor runs stay fast."""
    import hashlib

    st = os.stat(path)
    key = f"{os.path.abspath(path)}:{st.st_size}:{int(st.st_mtime)}"
    cache_path = str(MD5_CACHE)
    cache: dict = {}
    try:
        with open(cache_path) as f:
            cache = json.load(f)
    except (OSError, ValueError):
        pass
    if key in cache:
        return cache[key]
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    cache[key] = h.hexdigest()
    try:
        os.makedirs(os.path.dirname(cache_path), exist_ok=True)
        with open(cache_path, "w") as f:
            json.dump(cache, f)
    except OSError:
        pass
    return cache[key]


def released_weights_report() -> dict:
    """Machine-readable precondition for the real-weight parity gate
    (cli/parity_check.py): which released checkpoints are present, where
    the framework looked, and the one command to run once they exist."""
    dirs = _weight_search_dirs()
    found: dict[str, dict] = {}
    for spec in RELEASED_WEIGHTS:
        for d in dirs:
            path = os.path.join(d, spec["file"])
            if os.path.isfile(path):
                md5 = _md5_cached(path)
                entry = {
                    "path": path,
                    "bytes": os.path.getsize(path),
                    "md5": md5,
                }
                if spec["md5_prefix"]:
                    entry["md5_matches_name"] = md5.startswith(spec["md5_prefix"])
                found[spec["file"]] = entry
                break
    required = [s["file"] for s in RELEASED_WEIGHTS[:2]]
    present = all(f in found for f in required)
    report = {
        "expected": RELEASED_WEIGHTS,
        "search_dirs": dirs,
        "found": found,
        "parity_gate_ready": present,
    }
    if present:
        b = found[required[0]]["path"]
        d = found[required[1]]["path"]
        report["run"] = (
            "python -m helping_hand_for_egocentric_videos_torch.cli.parity_check "
            f"--backbone_ckpt {b} --decoder_ckpt {d} "
            "--egomcq_meta <meta> --egomcq_data <videos> "
            "--epic_meta <meta> --epic_data <videos>"
        )
    else:
        report["blocked_on"] = [f for f in required if f not in found]
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--timeout", type=float, default=60.0,
                   help="seconds to wait for the device")
    p.add_argument("--device", default="cuda",
                   help="the device to diagnose (default: the CUDA device; 'cpu' must be asked for)")
    args = p.parse_args(argv)
    report = collect(timeout=args.timeout, device=args.device)
    print(json.dumps(report, indent=2))
    return 0 if report["usable"] else 1


if __name__ == "__main__":
    sys.exit(main())
