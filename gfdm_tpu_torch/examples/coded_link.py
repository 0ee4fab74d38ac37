#!/usr/bin/env python3
"""Coded GFDM link: conv-coded bursts, soft LLRs, batched Viterbi decoding.

Demonstrates the coding gain of the rate-1/2 K=7 convolutional code over
the uncoded link at equal Eb/N0, and - under a frequency-selective channel -
the LLR-quality advantage of the CNR-weighted MMSE equalizer over plain ZF
(the reference's only equalizer, gr-gfdm/lib/receiver_kernel_cc.cc:309-320).
One burst carries one zero-terminated codeword; decoding is one batched
Viterbi over the whole burst batch. The port of examples/coded_link.py on
the card (``--device cpu``: on the CPU); the noise from a CPU
torch.Generator.
"""
from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.eval.coded import coded_ber_point, coded_vs_uncoded

EBN0_DB = [1.0, 2.0, 3.0, 4.0, 5.0]
MULTIPATH_EBN0_DB = (6.0, 9.0, 12.0)


def main(bursts=256, multipath_bursts=384, device=None):
    cfg = GfdmConfig()
    print("=== AWGN: coded vs uncoded at equal Eb/N0 (QPSK, rate 1/2 K=7) ===")
    res = coded_vs_uncoded(cfg, EBN0_DB, bursts=bursts, seed=1, device=device)
    print(f"{'Eb/N0 dB':>9} {'coded BER':>11} {'uncoded BER':>12}")
    for i, e in enumerate(res["ebn0_db"]):
        print(f"{e:9.1f} {res['coded_ber'][i]:11.2e} "
              f"{res['uncoded_ber'][i]:12.2e}")

    print("\n=== multipath (8-tap Rayleigh): equalizer LLR quality ===")
    print(f"{'Eb/N0 dB':>9} {'zf coded':>11} {'mmse_cnr coded':>15}")
    multipath = {}
    for e in MULTIPATH_EBN0_DB:
        zf = coded_ber_point(cfg, e, bursts=multipath_bursts, equalizer="zf",
                             channel="multipath", seed=11, device=device)
        cnr = coded_ber_point(cfg, e, bursts=multipath_bursts, equalizer="mmse_cnr",
                              channel="multipath", seed=11, device=device)
        multipath[e] = (zf, cnr)
        print(f"{e:9.1f} {zf:11.2e} {cnr:15.2e}")
    return {"awgn": res, "multipath": multipath}


if __name__ == "__main__":
    from gfdm_tpu_torch.examples import parse_device

    main(device=parse_device(__doc__))
