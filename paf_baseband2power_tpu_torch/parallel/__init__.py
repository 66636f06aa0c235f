"""Multi-device and multi-host runtime: one rank per device."""
