"""The repo's end-to-end example scripts, ported (counterparts of the files
of the same names under ``examples/``):

- ``reproduce``: retrain the cheap rows of the README's results table from
  pinned seeds and hold each to its claim;
- ``distill_vision``: a privileged state-based BPTT teacher distilled into a
  depth-camera student by DAgger;
- ``train_imported_mesh``: BPTT in an imported triangle-mesh scene;
- ``mesh_assets``: the synthetic garage OBJ the mesh examples train in.

Each runs as ``python -m visfly_tpu_torch.examples.<name>`` on the CUDA card.
"""
