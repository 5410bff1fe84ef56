"""Entry points: ``python -m dlmc_quant_torch.examples.<name> -c <yaml>``."""
