"""Plain PyTorch references of what the benchmark's cells run: float32
arithmetic, TF32 off, no kernel and nothing of the program under test. Each
model family's file (``<family>.py``, named by a configuration's
``reference``) makes the weights both sides start from and recomputes the
program's outputs from the benchmark's own inputs."""
