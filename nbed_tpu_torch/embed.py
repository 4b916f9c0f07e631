"""Public entry point: ``nbed(config | path | kwargs, device=...)``, and the
command line ``nbed-tpu-torch --config <file.json> [--device cuda|cpu]``
(also ``python -m nbed_tpu_torch.embed``)."""

from .config import NbedConfig, parse_config
from .profiling import request, span

__all__ = ["nbed", "cli"]


def nbed(config: "NbedConfig | str | None" = None, device="cuda", **config_kwargs):
    """Run the full embedding pipeline on ``device`` and return the driver.

    Accepts a validated :class:`NbedConfig`, a path to a JSON config file, or
    bare keyword arguments. ``device`` is ``"cuda"`` (default; raises where
    no CUDA device exists) or ``"cpu"``.

    Returns:
        NbedDriver: the completed driver with ``mu`` / ``huzinaga`` result
        dicts, ``embedded_scf`` and ``classical_energy`` populated, and
        ``timings``: the host seconds of every span of the call (one
        request, :func:`nbed_tpu_torch.profiling.request`) by name.
    """
    from .driver import NbedDriver

    with request(device):
        with span("driver.init"):
            driver = NbedDriver(parse_config(config, **config_kwargs), device=device)
        driver.embed()
    return driver


def cli(argv=None) -> None:
    """Console entry point: set up logging (``.nbed.log``), run the config
    on the device asked for and print the classical energy of each
    projector's embedded result."""
    from .utils import parse, setup_logs

    setup_logs()
    config, device = parse(argv)
    driver = nbed(config, device=device)
    for name in ("mu", "huzinaga"):
        result = getattr(driver, name, None)
        if result:
            print(f"{name}: classical_energy = {result['classical_energy']!r}")


if __name__ == "__main__":
    cli()
