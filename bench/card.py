"""The card the benchmark runs on: its clock, memory and profiler.

The harness speaks to the device only through a ``Card``; a card that
is not there is an error, never a fall back to the CPU.
"""
from __future__ import annotations

import subprocess


class NoCard(RuntimeError):
    """The cell asks for more cards than ``torch.cuda`` sees."""


class CudaCard:
    """Card 0 of ``torch.cuda``; the run uses ``chips`` cards."""

    platform = "gpu"

    def __init__(self, torch, chips: int):
        if not torch.cuda.is_available():
            raise NoCard("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < chips:
            raise NoCard(f"the cell needs {chips} cards, torch.cuda sees "
                         f"{torch.cuda.device_count()}")
        self.torch = torch
        self.device = torch.device("cuda", 0)
        torch.cuda.set_device(self.device)
        self.kind = torch.cuda.get_device_name(self.device)
        self.count = chips

    def synchronize(self) -> None:
        self.torch.cuda.synchronize(self.device)

    def reset_peak(self) -> None:
        self.torch.cuda.reset_peak_memory_stats(self.device)

    def peak_bytes(self) -> int:
        return int(self.torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        self.torch.cuda.empty_cache()

    def event(self):
        return self.torch.cuda.Event(enable_timing=True)

    @staticmethod
    def elapsed_s(start, end) -> float:
        return start.elapsed_time(end) / 1e3

    def profiler_activities(self):
        from torch.profiler import ProfilerActivity
        return [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def device_event_type(self):
        return self.torch.autograd.DeviceType.CUDA

    def power_limit(self) -> str:
        """The card's name and power limit as ``nvidia-smi`` reads them
        ("not read" where it cannot)."""
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader", "-i", "0"],
                capture_output=True, text=True, timeout=30, check=True)
        except (OSError, subprocess.SubprocessError):
            return "not read"
        return out.stdout.strip() or "not read"
