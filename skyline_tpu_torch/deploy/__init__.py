"""The deployment and operations plane above the worker.

The port's counterpart of the repo root's ``deploy/launch.py`` and of the
operational drills ``scripts/{serve,chaos,mesh,obs}_smoke.sh``:

- ``launch``: the one-command launcher
  (``python -m skyline_tpu_torch.deploy.launch [--demo]``) that starts the
  kafkalite broker, the worker, the collector and (with ``--demo``) a
  bounded producer as supervised processes;
- ``drills``: the four acceptance drills as Python modules
  (``python -m skyline_tpu_torch.deploy.drills {serve,chaos,mesh,obs,all}
  [--device cuda|cpu]``).

Importing this package loads neither ``torch`` nor anything of the JAX
package; the drills import the port lazily, inside each leg.
"""
