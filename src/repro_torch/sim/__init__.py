"""Inputs of the serving simulation: the synthetic traffic of workloads.py."""
