"""gfdm_tpu_torch: the PyTorch and CUDA port of gfdm_tpu.

The JAX package ``gfdm_tpu`` is the reference; this package imports neither
it nor JAX. The layout follows the reference, so each module has a
counterpart of the same name:

- :mod:`.config` - :class:`GfdmConfig` (NumPy float64 host constants);
- :mod:`.ref` - the NumPy golden-model modules the operators need;
- :mod:`.ops` - operators (NumPy), planar primitives, the planar link and
  the detection/extraction path as plain torch ops, and the complex-dtype
  ops (Tx, estimation, receiver, detection, extraction) on complex64
  tensors;
- :mod:`.kernels` - a counterpart of every Pallas kernel of the reference:
  the fused Tx (one port or every CDD port), the receiver with every option,
  the one-kernel link, the superseded receivers, the large-K factored
  kernels, the two detection front-end kernels and the link's GEMM chain
  (f32, bf16, int8), written in CUDA C++ for Hopper (``csrc/``), each with
  its plain torch version;
- :mod:`.parallel` - the device mesh (a device may repeat), the halo
  exchange, sample-axis-sharded detection, the metrics' sum, and the
  multi-process serve over a gloo group;
- :mod:`.runtime` - chunked streams, the streaming receive service over a
  mesh (sample-axis sharded with ``sp_shards > 1``; the coded modem,
  ``fec="conv"``), the streaming transmit service on the
  Tx kernel with its UDP sink, the burst scheduler, the complex-dtype
  transmitter / receiver chain and the channel simulation;
- :mod:`.native` - the host runtime over ``csrc/gfdm_host.cpp`` (built with
  g++ at first use): sc16 converters, the stream ring and its file / UDP
  ingest threads;
- :mod:`.coding`, :mod:`.ops.softbits`, :mod:`.cli`, :mod:`.utils.framing`
  - the rate-1/2 K=7 code with its Viterbi decoder (torch ops), max-log
  soft bits, and the CRC-32 payload framing; :mod:`.utils.converter` - sc16
  <-> complex in NumPy; :mod:`.utils.profiling` - the stage timer (CUDA
  events) and profiler traces;
- :mod:`.eval` - the coded service's sensitivity sweep;
- :mod:`.device` - where an entry point runs: the card unless the caller
  passes ``device="cpu"``;
- :mod:`.entry` - the main-path step, the service's synthetic stream and
  the multi-chip / multi-process dry runs,
  :mod:`.convert` - constants carried over from the JAX package;
- :mod:`.benchmarks` - the benchmarks run on the card
  (``python -m gfdm_tpu_torch.benchmarks.int8_gauss``).
"""
from .config import GfdmConfig

__all__ = ["GfdmConfig"]
__version__ = "0.1.0"
