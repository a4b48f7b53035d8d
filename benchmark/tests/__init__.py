"""CPU tests of the benchmark (and, marked ``cuda``, its checks on the card)."""
