"""Network descriptions the port needs (a copy of ``repro.core.netinfo``'s VGG part)."""
