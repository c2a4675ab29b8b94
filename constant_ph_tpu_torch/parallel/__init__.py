"""pH replica exchange (port of constant_ph_tpu/parallel). The spatial
sharding and the cross-device merges come with the multi-GPU slice."""
