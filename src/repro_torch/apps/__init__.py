"""repro_torch.apps — applications over the operator layer (HPCG)."""
