"""Host helpers: payload framing (bit packing and CRC-32), sc16 IQ format
conversion, and stage timing (``profiling``)."""
