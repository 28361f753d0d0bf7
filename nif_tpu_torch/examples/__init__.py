"""The tutorials on the port: ``examples/01-13`` of the JAX package, each
run on ``nif_tpu_torch`` (``python -m nif_tpu_torch.examples.<name>``).

The file names keep the JAX package's, digits first, so a module is loaded
with ``importlib.import_module("nif_tpu_torch.examples.13_paper_scale_3d")``
or run with ``python -m``. Each keeps its counterpart's public functions,
their defaults and command-line flags, and adds one ``device`` argument
(``--device``): ``"cuda"`` by default, ``"cpu"`` to run without a card. A
file imports ``torch`` and ``nif_tpu_torch`` only, and keeps its own copy of
its data generator. Examples 04, 11 and 13 also expose the stage after
training as a function of ``(model, data)``.
"""
