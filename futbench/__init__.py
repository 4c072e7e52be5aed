"""futbench: the benchmark of the PyTorch and CUDA port of the FutbolEnv
engine and its self-play PPO learner (``gym_futbol_tpu_torch``). See
``futbench/README.md``."""
