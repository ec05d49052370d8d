"""zkbench: the benchmark of the PyTorch and CUDA prover
(`zukelang_tpu_torch`).  `python3 -m zkbench.run --help`; README.md
says how the files fit together."""
