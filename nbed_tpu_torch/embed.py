"""Public entry point: ``nbed(config | path | kwargs, device=...)``."""

from .config import NbedConfig, parse_config

__all__ = ["nbed"]


def nbed(config: "NbedConfig | str | None" = None, device="cuda", **config_kwargs):
    """Run the full embedding pipeline on ``device`` and return the driver.

    Accepts a validated :class:`NbedConfig`, a path to a JSON config file, or
    bare keyword arguments. ``device`` is ``"cuda"`` (default; raises where
    no CUDA device exists) or ``"cpu"``.

    Returns:
        NbedDriver: the completed driver with ``mu`` / ``huzinaga`` result
        dicts, ``embedded_scf`` and ``classical_energy`` populated.
    """
    from .driver import NbedDriver

    driver = NbedDriver(parse_config(config, **config_kwargs), device=device)
    driver.embed()
    return driver
