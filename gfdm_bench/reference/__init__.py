"""The benchmark's plain reference: the pygfdm golden modules (``pygfdm/``,
a frozen NumPy copy), a batched PyTorch restatement of the same link
(``waveform``), a plain detection and extraction (``sync``), the precisions a
stage may be computed in (``precision``) and the traffic generator
(``traffic``). Nothing here imports the program under test or JAX.
"""
