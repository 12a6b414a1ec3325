"""Collectives, fusion, compression and the fused loss of the port."""
