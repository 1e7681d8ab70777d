"""Workloads of the port."""
