"""A node's identity and address (the port's copy of
pilosa_tpu/cluster/node.py), which a standalone node reports. The rest of
the cluster layer comes with ROADMAP.md Queue 1: cluster and operations."""
