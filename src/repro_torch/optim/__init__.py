"""The optimizer (AdamW) and the power-method gradient compression."""
