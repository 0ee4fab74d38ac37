"""Scripts that measure the benchmark itself: its spread (``sets``) and
the readings its limits are set from (``readings``)."""
