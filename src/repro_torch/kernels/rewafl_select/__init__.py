"""Fused REWAFL utility -> top-K selection kernel."""
