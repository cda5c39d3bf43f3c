"""The experiment layer's helpers (counterpart of ``visfly_tpu/utils/``):
config loading, checkpoints, the metric logger, figure theming, the
evaluation harness, profiling, debugging, the PRM path planner and the
sim-to-real replay. ``dataloader.py`` is not ported yet (ROADMAP Queue A
item 20)."""
