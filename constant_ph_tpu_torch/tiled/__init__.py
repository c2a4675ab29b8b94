"""The hot path on cell tiles.

- layout.py  — tile parameters, tiled state, canonical⇄tiled conversion,
  molecule-level re-binning
- forces.py  — water-water / water-solute / solute-solute blocks: the
  hot path, the tally path, and the plain versions of both kernels
- cuda_ww.py — build and launch of the CUDA water-water kernels
  (csrc/ww_pair.cu, csrc/ww_tally.cu)
- shake.py   — SHAKE/RATTLE on tile-resident rigid water
- engine.py  — the TiledEngine
"""
