"""Protocol sanitizers of the serving stack (port of ``repro/analysis``):

  ``analysis.races``   happens-before model of the ``DecodeStep``
                       lifecycle: exhaustive in-process interleaving
                       exploration plus offline replay of ``obs``
                       TraceLog JSONL (``python -m
                       repro_torch.analysis.races trace.jsonl
                       --require-pipeline``).
  ``analysis.refsan``  opt-in ``BlockPool`` shadow refcount sanitizer:
                       leaks, double-frees and use-after-free with
                       call-site provenance.
  ``analysis.lint``    the AST protocol lint (``python -m
                       repro_torch.analysis.lint [paths]``): the
                       reference's rules but ``pallas-fetch-gate``.
"""
import importlib

__all__ = ["lint", "races", "refsan"]


def __getattr__(name):
    # lazy submodule access (keeps `python -m repro_torch.analysis.races`
    # runnable without a double-import warning)
    if name in __all__:
        return importlib.import_module(f"repro_torch.analysis.{name}")
    raise AttributeError(name)
