"""Command-line launchers; counterpart of ``repro/launch/`` (``serve``;
the others are ROADMAP Queue 1 item 13i)."""
