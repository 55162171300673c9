"""The benchmark of the PyTorch and CUDA port
(``option_pricing_ffn_lbfgs_tpu_torch``): ``python3 -m benchmark.run``.
See ``harness.py`` for how a cell's pieces are found and run."""
