"""Scheme grammar, quantized layers, chained int8 deploy."""
