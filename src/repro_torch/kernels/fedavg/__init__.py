"""Weighted FedAvg aggregation kernel."""
