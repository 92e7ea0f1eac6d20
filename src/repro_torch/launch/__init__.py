"""Launchers: the LM train steps (``train``), the logical-axis rules and
production meshes (``mesh``), input and cache specs (``specs``), and the
dry run (``dryrun``) with its per-device counters (``cost_analysis``)."""
