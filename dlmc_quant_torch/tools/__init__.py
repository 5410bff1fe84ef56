"""Measurement tools of the port, each run as ``python -m
dlmc_quant_torch.tools.<name>`` on the card: ``gemm_sweep`` (int8 GEMM rate
against shape), ``mma_probe`` (int8 tensor-core rate with operands in
shared memory), ``gemm_ceiling`` (PyTorch's own int8 and bf16 GEMMs) and
``accuracy_protocol`` (top-1 of trained models through PTQ, QAT and the
integer paths)."""
