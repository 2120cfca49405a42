"""Command-line launchers and the mesh; counterpart of ``repro/launch/``
(``search``, ``codesign_serve``, ``serve``, ``train``, ``mesh``;
``dryrun`` is ROADMAP Queue 1 item 13i)."""
