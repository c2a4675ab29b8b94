"""Native (C++) host components of the port, loaded with ctypes: the
LAMMPS data-file parser (lammps_data.cpp) and the bond-graph exclusion
builder (topology.cpp). Both are the port's own copies of the JAX
package's sources, compiled with g++ at first use into
``constant_ph_tpu_torch/_build/`` (build.load_library)."""
