"""hhbench: the benchmark of ``helping_hand_for_egocentric_videos_torch``.

``python3 hhbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` on the CUDA device and prints one JSON
line. Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<traffic>.json`` (read by the driver
``mixes/<driver>.py`` that it names), ``workloads/<cell>.json`` and
``metrics/<metric>.py``. ``counts/`` holds the yardstick's arithmetic and
``reference/`` the plain PyTorch reference that decides ``correct``.
"""
