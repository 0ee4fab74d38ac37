"""Host helpers: payload framing (bit packing and CRC-32) and sc16 IQ
format conversion."""
