"""Layers, attention and transformer stacks, as plain functions over
nested dicts of tensors (and small modules for the FL models)."""
