"""Resource monitor: a daemon thread sampling the run's host and device use.

Counterpart of ``beta_recsys_tpu/utils/monitor.py``: every ``delay`` seconds
it samples the process's CPU share and resident memory (with ``psutil``,
where it is installed) and the device memory that PyTorch holds
(``torch.cuda.memory_allocated`` on a CUDA device, 0 elsewhere), and writes
them to a TensorBoard-style ``writer`` when one is given. ``stop()`` returns
the wall-clock run time, the ``run_time`` of ``Recommender.train``.
"""

import os
import threading
import time

import torch

try:
    import psutil
except ImportError:  # the card's machine has no psutil
    psutil = None


class Monitor:
    """Sample process and device use every ``delay`` seconds until stopped."""

    def __init__(self, log_dir=None, delay=1.0, device=None, writer=None):
        self.delay = delay
        self.log_dir = log_dir
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.writer = writer
        self.samples = []
        self._start_time = time.time()
        self._stop_event = threading.Event()
        self._proc = psutil.Process(os.getpid()) if psutil else None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def device_memory_bytes(self):
        """Bytes PyTorch's allocator holds on the device (0 off CUDA)."""
        if self.device.type != "cuda":
            return 0
        return torch.cuda.memory_allocated(self.device)

    def _run(self):
        step = 0
        while not self._stop_event.wait(self.delay):
            sample = {"t": time.time() - self._start_time}
            if self._proc is not None:
                sample["cpu_percent"] = self._proc.cpu_percent()
                sample["rss_mb"] = self._proc.memory_info().rss / 2**20
            sample["device_mem_mb"] = self.device_memory_bytes() / 2**20
            self.samples.append(sample)
            if self.writer is not None:
                for k, v in sample.items():
                    if k != "t":
                        self.writer.add_scalar(f"device/{k}", v, step)
            step += 1

    def stop(self):
        """Stop sampling; the wall-clock run time in seconds."""
        self._stop_event.set()
        self._thread.join(timeout=2 * self.delay + 1)
        return time.time() - self._start_time
