"""A UDP ingest on a free loopback port, for tests that run side by side.

The OS picks the port (a socket bound to port 0), which the ingest then
binds; if another process takes it in between, the bind fails with OSError
and another port is picked.
"""
import socket


def free_udp_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def udp_ingest(native, ring, tries: int = 20, **kw):
    """``native.UdpIngest`` on a free port (``.port`` says which)."""
    for _ in range(tries):
        try:
            return native.UdpIngest(free_udp_port(), ring, **kw)
        except OSError:
            continue
    raise OSError(f"no free UDP port in {tries} tries")
