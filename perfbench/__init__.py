"""The benchmark of the PyTorch and CUDA port (`repro_torch`): see
README.md in this folder and BENCHMARK.json at the root."""
