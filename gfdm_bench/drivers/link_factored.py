"""The large-K link: ``gfdm_tpu_torch.kernels.fused.link_step_factored``
with the cell's IC iterations and estimator, on batches of QPSK payloads
(see ``common.LinkDriver``); the step returns no SNR."""
from __future__ import annotations

from gfdm_bench.common import LinkDriver


class Driver(LinkDriver):
    def program_setup(self) -> None:
        from gfdm_tpu_torch.kernels.fused import link_step_factored

        self.link = link_step_factored

    def step(self, data):
        d_hat, evm = self.link(self.cfg, data, ic_iterations=int(self.p["ic_iterations"]),
                               estimator=self.p["estimator"])
        return d_hat, None, evm
