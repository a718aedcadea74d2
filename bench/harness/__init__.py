"""The benchmark harness of the PyTorch/CUDA port of Teola (``repro_torch``).

``bench/run.py`` is the one command; these modules are its parts. Nothing
here imports ``jax``, ``jaxlib``, ``flax`` or ``repro``. The modules that
make the yardstick (``traffic``, ``corpus``, ``work``, ``trace``,
``reference``, ``check``, ``stats``, ``weights``, ``cells``) import
nothing of ``repro_torch`` either: ``system`` stands the program up and
records around it, ``window`` and ``runner`` drive it.
"""
