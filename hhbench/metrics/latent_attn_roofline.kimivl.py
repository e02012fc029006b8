"""``ops/latent_attention.py`` and ``csrc/latent_softmax.cu`` (the decode
steps' latent attention over each clip's prefix and each sequence's tail):
the least time of the traced batch's latent attention
(``counts.kimivl.latent_attn_least_seconds``: each clip's prefix of latents
read once a step and layer, each sequence's tail, the query rows and the
outputs, at the card's bandwidth) over the device time of its kernels, in
percent. The decode steps replay CUDA graphs, inside which no span runs,
so the kernels are read from the trace: each ``latent_softmax_kernel`` and
the two kernels before it and after it on the device (the prefix's and the
tail's score products, the two weighted sums: ``attend``'s five launches),
which must be GEMMs. None without them (a CPU run, or a program without
the kernel)."""

from hhbench.counts.kimivl import latent_attn_least_seconds

KERNEL = "latent_softmax_kernel"
SIDE = 2  # the launches of ``ops/latent_attention.py::attend`` before and after the softmax
GEMMS = ("gemm", "Gemm", "nvjet", "xmma", "cutlass", "sm90_", "sm80_")


def read(run):
    tr = run.trace_data
    if tr is None or not run.traced_items:
        return None
    kernels = sorted(tr.kernels(), key=lambda e: e[1])
    marks = [i for i, e in enumerate(kernels) if KERNEL in e[0]]
    if not marks:
        return None
    taken = set()
    for i in marks:
        around = [j for j in range(i - SIDE, i + SIDE + 1) if j != i]
        if around[0] < 0 or around[-1] >= len(kernels):
            return None
        if not all(any(g in kernels[j][0] for g in GEMMS) for j in around):
            return None
        taken.update(around + [i])
    seconds = sum(kernels[j][2] for j in taken) / 1e6
    least = latent_attn_least_seconds(run.cfg, run.traced_items, run.cfg["precision"]["lm"], run.peaks())
    return 100.0 * least / seconds
