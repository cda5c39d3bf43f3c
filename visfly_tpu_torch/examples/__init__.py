"""The repo's end-to-end example scripts, ported (counterparts of the files
of the same names under ``examples/``):

- ``reproduce``: retrain the cheap rows of the README's results table from
  pinned seeds and hold each to its claim;
- ``distill_vision``: a privileged state-based BPTT teacher distilled into a
  depth-camera student by DAgger;
- ``train_imported_mesh``: BPTT in an imported triangle-mesh scene;
- ``mesh_assets``: the synthetic garage OBJ the mesh examples train in;
- ``debug_obs``, ``habitat_dataset_demo``, ``vision_grad_probe``: the
  debugging and demo scripts;
- ``fps_test``: agent steps a second of the reference's env configurations;
- ``tri_bench``: the exact-triangle render on the garage subdivided to
  92,160 triangles, with its prepass and kernel timed apart.

Each runs as ``python -m visfly_tpu_torch.examples.<name>`` on the CUDA card.
"""
