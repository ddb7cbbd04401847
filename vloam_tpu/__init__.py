"""The package's earlier name, kept as an alias: ``import <this>.x`` gives
the module object ``vloam.x`` (one copy of each module, so jit caches and
class identities are shared), and ``python -m <this> run`` runs the vloam
CLI."""

import importlib
import importlib.abc
import importlib.util
import sys

import vloam

_PREFIX = __name__ + "."


class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves ``<this>.x`` to the already-importable ``vloam.x``."""

    def find_spec(self, name, path=None, target=None):
        if name.startswith(_PREFIX) and name != _PREFIX + "__main__":
            return importlib.util.spec_from_loader(name, self)
        return None

    def create_module(self, spec):
        module = importlib.import_module("vloam." + spec.name[len(_PREFIX):])
        spec.loader_state = module.__spec__
        return module

    def exec_module(self, module):
        # the import system stamped the alias spec on the shared module
        module.__spec__ = module.__spec__.loader_state


sys.meta_path.insert(0, _Alias())
sys.modules[__name__] = vloam
