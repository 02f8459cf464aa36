"""Dense decoder stacks for serving (layers, attention, transformer, model)."""
