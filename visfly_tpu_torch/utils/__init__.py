"""The experiment layer's helpers (counterpart of ``visfly_tpu/utils/``):
config loading, checkpoints, the metric logger, figure theming, the
evaluation harness, profiling, debugging, the PRM path planner, the
sim-to-real replay and the scene-path dataloader."""
