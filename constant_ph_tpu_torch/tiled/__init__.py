"""The hot path on cell tiles.

- layout.py  — tile parameters, tiled state, canonical⇄tiled conversion,
  molecule-level re-binning
- forces.py  — water-water / water-solute / solute-solute blocks
- cuda_ww.py — build and launch of the CUDA water-water kernel
  (csrc/ww_pair.cu)
- shake.py   — SHAKE/RATTLE on tile-resident rigid water
- engine.py  — the TiledEngine
"""
