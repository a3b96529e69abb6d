"""The device-plugin daemon: discovery to Allocate, for NVIDIA cards."""
