"""Out-of-band emission + PAPR study: GFDM vs plain OFDM.

The quantified version of the reference's spectrum plots
(gfdm_plot_utils.py) and PAPR experiment (zadoff_chu.py __main__):
identical QPSK payload grids modulated three ways, then OOB attenuation
(in-band vs out-of-band mean PSD) and the PAPR CCDF. The port of
examples/spectrum_study.py: the golden model builds the signals, the
measures run on the card (``--device cpu``: on the CPU).

Run: python -m gfdm_tpu_torch.examples.spectrum_study [--device cpu]
Saves spectrum_study.png when matplotlib is available.
"""
import numpy as np

from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.eval.spectrum import spectrum_study, welch_psd


def main(n_bursts=128, device=None, png="spectrum_study.png"):
    cfg = GfdmConfig()
    res = spectrum_study(cfg, n_bursts=n_bursts, device=device)
    print(f"config: K={cfg.subcarriers} active={cfg.active_subcarriers} "
          f"M={cfg.timeslots} {cfg.filtertype} alpha={cfg.filteralpha} "
          f"ramp={cfg.ramp_len}")
    print(f"{'waveform':>12}  {'OOB atten':>10}  {'median PAPR':>12}")
    for name in ("gfdm_frame", "gfdm_core", "ofdm"):
        r = res[name]
        print(f"{name:>12}  {r['oob_attenuation_db']:7.2f} dB"
              f"  {r['papr_median_db']:9.2f} dB")
    print("\nPAPR CCDF  P(PAPR > x):")
    t = res["ofdm"]["papr_thresholds_db"]
    print("  x[dB]:   " + "  ".join(f"{x:5.1f}" for x in t[::2]))
    for name in ("gfdm_frame", "ofdm"):
        c = res[name]["papr_ccdf"]
        print(f"  {name:>10} " + "  ".join(f"{v:5.3f}" for v in c[::2]))
    if png is None:
        return res

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from gfdm_tpu_torch.eval.spectrum import _ofdm_modulate, _payload_grids
        from gfdm_tpu_torch.ref import cyclic_prefix as ref_cp
        from gfdm_tpu_torch.ref import modulation as ref_modulation

        grids = _payload_grids(cfg, n_bursts, 7)
        core = np.stack(
            [ref_modulation.modulate_block(g, cfg.tx_filter_taps, cfg.overlap)
             for g in grids]
        )
        framed = np.stack(
            [ref_cp.add_cyclic_prefix(b, cfg.cp_len, cfg.cs_len,
                                      cfg.window_taps, cfg.ramp_len)
             for b in core]
        )
        fig, ax = plt.subplots(figsize=(7, 4))
        for name, sig in (("GFDM frame (windowed)", framed),
                          ("plain OFDM", _ofdm_modulate(grids))):
            f, p = welch_psd(sig, device=device)
            ax.plot(f, 10 * np.log10(p / p.max() + 1e-12), label=name)
        ax.set_xlabel("frequency [cycles/sample]")
        ax.set_ylabel("normalized PSD [dB]")
        ax.legend(); ax.grid(True)
        fig.savefig(png, dpi=120, bbox_inches="tight")
        plt.close(fig)
        print(f"\nwrote {png}")
    except ImportError:
        print("\n(matplotlib unavailable - numbers only)")
    return res


if __name__ == "__main__":
    from gfdm_tpu_torch.examples import parse_device

    main(device=parse_device(__doc__))
