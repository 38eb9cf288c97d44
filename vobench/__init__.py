"""vobench: the benchmark of rso_torch, the PyTorch and CUDA stereo VO.

`python3 vobench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once; see README.md.
"""
