"""repro_torch.core — NeuRRAM behavioral model and chip compiler (port of
`repro/core`). Import the submodules directly (`core.cim`, `core.mapping`)."""
