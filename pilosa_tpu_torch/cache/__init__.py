"""Per-request tenant identity (the port's copy of
pilosa_tpu/cache/tenant.py). The result cache it partitions in the JAX
package comes with ROADMAP.md Queue 1: executor remainder."""
