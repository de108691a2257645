"""A stand-in for the card, for driving the harness on the CPU in
tests: the harness never falls back to the CPU by itself."""
import time


class _Mark:
    def record(self):
        self.t = time.perf_counter()


class HostCard:
    platform = "cpu"
    kind = "host CPU (test stand-in)"
    count = 1

    def __init__(self, torch):
        self.torch = torch
        self.device = torch.device("cpu")

    def synchronize(self):
        pass

    def reset_peak(self):
        pass

    def peak_bytes(self):
        return 0

    def free(self):
        pass

    def event(self):
        return _Mark()

    @staticmethod
    def elapsed_s(start, end):
        return end.t - start.t

    def profiler_activities(self):
        from torch.profiler import ProfilerActivity
        return [ProfilerActivity.CPU]

    def device_event_type(self):
        return self.torch.autograd.DeviceType.CUDA

    def power_limit(self):
        return "not read"
