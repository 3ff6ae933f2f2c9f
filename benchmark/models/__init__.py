"""One module per model kind (a configuration's ``model.kind``), found by
name: its initial parameters, its operations an epoch and its plain
forward pass for the reference."""
