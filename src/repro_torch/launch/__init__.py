"""Command-line launchers; counterpart of ``repro/launch/`` (``search``,
``codesign_serve``, ``serve``; ``train``, ``dryrun`` and ``mesh`` are
ROADMAP Queue 1 item 13i)."""
