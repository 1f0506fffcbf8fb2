"""A stand-in for the card, so that the tests drive a run on the CPU
(the benchmark itself refuses to run without a card)."""

import time

import torch


class _Event:
    def record(self):
        self.t = time.perf_counter()


class HostClock:
    cuda = False
    device = torch.device("cpu")

    def event(self):
        return _Event()

    @staticmethod
    def ms(a, b) -> float:
        return (b.t - a.t) * 1e3

    def sync(self):
        pass

    def peak_bytes(self) -> int:
        return 0

    def release(self):
        pass

    def kind(self) -> str:
        return "cpu"
