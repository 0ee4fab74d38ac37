"""Host helpers: payload framing (bit packing and CRC-32)."""
