"""Layers the FL models need, as plain functions and small modules."""
