"""Drives of the port, each run with ``python -m``; importing does nothing.

``scaling_bench`` times the sharded update over meshes of 1..n cards;
``scaling_model_report`` evaluates the analytic scaling model
(:mod:`..parallel.scaling_model`) on the bench case.
"""
