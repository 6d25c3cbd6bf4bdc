"""The benchmark of ``pydeseq2_tpu_torch``, the PyTorch and CUDA port, on
an NVIDIA card: DESeq2 studies back to back at the widths of public count
matrices. Run a cell with ``python3 -m dea_bench.run`` (see ``run.py``);
``BENCHMARK.json`` at the root of the checkout names the cells."""
