"""Model zoo (plain functions on tensors, parameters in dictionaries)."""
