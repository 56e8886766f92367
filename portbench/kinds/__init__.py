"""Traffic kinds: one module each, `<kind>.py`, found by the `kind` of a
traffic mix (portbench/manifest.kind_module)."""
