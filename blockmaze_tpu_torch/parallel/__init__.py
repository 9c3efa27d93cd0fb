"""Proving over several devices: a mesh of torch devices in one process
(mesh.py), the sharded NTT (sntt.py), the sharded QAP (sqap.py), and the
process group of a multi-process run (distributed.py)."""
