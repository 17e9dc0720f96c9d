"""Multi-device training: the ("data", "model") mesh (mesh.py) and ring
attention over the point axis (ring_attention.py)."""
