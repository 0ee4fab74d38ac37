"""The flagship link: the step ``gfdm_tpu_torch.entry.entry(device)``
returns, on batches of QPSK payloads (see ``common.LinkDriver``)."""
from __future__ import annotations

from gfdm_bench.common import LinkDriver


class Driver(LinkDriver):
    def program_setup(self) -> None:
        from gfdm_tpu_torch.entry import entry

        self.fn, _example = entry(self.device)

    def step(self, data):
        return self.fn(data)
