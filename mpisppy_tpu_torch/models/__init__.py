"""Model families of the port, copies of the JAX package's (the
reference's examples corpus, ref. SURVEY §2.6). Each module provides
``scenario_creator(name, **kwargs) -> Model``, ``make_tree(...) ->
ScenarioTree`` and ``scenario_denouement``."""

from . import farmer, hydro, uc, sizes, sslp, netdes, battery, ccopf  # noqa: F401
