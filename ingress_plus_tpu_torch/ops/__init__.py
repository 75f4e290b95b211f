"""Scan ops: plain PyTorch versions and the CUDA pair-scan kernel."""
