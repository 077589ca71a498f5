"""The benchmark of the PyTorch and CUDA port (``cfs_spmv_tpu_torch``):
``python3 spmv_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``, driven by ``BENCHMARK.json`` and the files of this
folder (see ``README.md``)."""
