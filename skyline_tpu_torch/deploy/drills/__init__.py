"""The repo's four operational acceptance drills, on the port.

    python -m skyline_tpu_torch.deploy.drills {serve,chaos,mesh,obs,all} [--device cuda|cpu]

Each drill (``serve``, ``chaos``, ``mesh``, ``obs``) asserts what its
reference script (``scripts/<name>_smoke.sh``) asserts, on the same
streams, fault plans, knob settings and bounds, prints the script's
``[<name>-smoke] ...`` progress lines and returns its evidence (digests,
counters, statuses, walls). The CLI prints one JSON line of that evidence
last and exits non-zero on any failed assertion. The default device is the
card; ``--device cpu`` runs the plain PyTorch path.

A drill's legs run in one interpreter: each starts from
``common.reset_process_state()`` and sets its knobs inside
``common.env_scope``, so what one leg pins does not reach the next.
"""

DRILLS = ("serve", "chaos", "mesh", "obs")
