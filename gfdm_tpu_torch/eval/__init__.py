"""Link evaluation harnesses (BER sweeps, coded links, SNR studies, spectrum
and PAPR, plotting, the coded service's sensitivity)."""
from .ber import ber_sweep  # noqa: F401
from .snr_study import snr_estimator_study  # noqa: F401
from .sensitivity import modem_sensitivity  # noqa: F401
from .spectrum import oob_attenuation, papr_ccdf, spectrum_study  # noqa: F401
