"""Map structures: the dense moment window and grid-spec helpers."""
