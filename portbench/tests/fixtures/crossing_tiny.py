from portbench.configs.crossing_swarm import Reference  # noqa: F401
