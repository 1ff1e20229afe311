"""What the harness knows of a model, one module a family of configurations.

A configuration file names its family under ``"family"``; the module
``perfbench.families.<family>`` provides:

- ``write_inputs(c, traffic, seed, workdir)``: the corpus of the traffic mix
  and any model directory the recipe reads, written under ``workdir``;
- ``overrides(c, workdir) -> list``: the recipe and the overrides that point
  it at what ``write_inputs`` wrote;
- ``param_shapes(c, n_tag) -> {name: shape}``: every weight of the model,
  for a tag vocabulary of ``n_tag``, and ``weight_rule(name, shape)``, how
  ``core.weights.make_weights`` fills each from the seed;
- ``reference_inputs(c, workdir, split)``: the reference's own reader of the
  written files, with ``tag_names`` and ``batch(program_batch, real) ->
  (inputs, entries that differ)``;
- ``first_steps(W, c, batches, tag_names, seed, alpha) -> dict``: the
  reference's first training steps (``loss``, ``grad``, ``change``, ``tied``
  as ``compare.train_readings`` reads them; optionally ``extra``, numbers or
  host arrays by name that ``compare.extra_readings`` holds against the
  program's);
- ``step_sizes(x, real) -> dict``: the real sizes of a step's batch;
- ``widths(c, n_tag) -> dict``: the widths handed to the per-layer readers;
- ``step_ops(widths, steps, launches, train) -> [{precision: ops}]``: the
  operations each step of a traced stretch needs, from its sizes and the
  recorded launches (``record.bounds``);
- ``KERNELS``: the ``record.Kernel`` entry points to record, each with its
  bound;
- optionally ``program_extra(pipe, batch) -> dict``: the program's side of
  the ``extra`` readings, given the built pipeline after the window and the
  first batch as the program fed it.
"""

from __future__ import annotations

import importlib


def load(c: dict):
    """The family module of configuration ``c``; a configuration that names
    none is refused."""
    if "family" not in c:
        raise ValueError("the configuration names no \"family\" (a module of perfbench.families)")
    return importlib.import_module(f"{__name__}.{c['family']}")
