"""Logging set-up, command-line parsing and XYZ helpers (port of
``nbed_tpu/utils.py``).

Not ported: ``pubchem_mol_geometry``, which fetches a geometry from the
PubChem web service; the port reads no network. Pass an XYZ string or file.
"""

import argparse
import json
import logging
import logging.config
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

__all__ = ["setup_logs", "parse", "build_ordered_xyz_string", "save_ordered_xyz_file"]


def setup_logs() -> None:
    """Initialise logging: a DEBUG file handler (``.nbed.log`` in the
    working directory, mode 'w') and a WARNING stream handler."""
    logging.config.dictConfig({
        "version": 1,
        "disable_existing_loggers": False,
        "formatters": {
            "standard": {"format": "%(asctime)s: %(name)s: %(levelname)s: %(message)s"},
        },
        "handlers": {
            "file_handler": {
                "class": "logging.FileHandler",
                "level": "DEBUG",
                "formatter": "standard",
                "filename": ".nbed.log",
                "mode": "w",
                "encoding": "utf-8",
            },
            "stream_handler": {
                "class": "logging.StreamHandler",
                "level": "WARNING",
                "formatter": "standard",
            },
        },
        "loggers": {
            "": {"handlers": ["file_handler", "stream_handler"], "level": "DEBUG"}
        },
    })
    # records logged at interpreter teardown, after a test runner has closed
    # the handlers' streams, are dropped instead of printing tracebacks
    logging.raiseExceptions = False
    logger.debug("Logging initialised.")


def parse(argv=None):
    """Parse the command line ``--config <file.json> [--device cuda|cpu]``
    into ``(NbedConfig, device)``. The JSON object is expanded as the
    config's keyword arguments."""
    from .config import NbedConfig

    parser = argparse.ArgumentParser(description="Output embedded qubit Hamiltonian.")
    parser.add_argument("--config", required=True, type=str,
                        help="Path to a JSON config file.")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="Device of the run (default: cuda).")
    args = parser.parse_args(argv)
    with open(Path(args.config).absolute()) as f:
        config_data = json.load(f)
    return NbedConfig(**config_data), args.device


def build_ordered_xyz_string(struct_dict: dict, active_atom_inds: list) -> str:
    """An XYZ string with the chosen active atoms listed first.

    The driver takes the active fragment as the leading ``n_active_atoms``
    of the geometry, so promoting the chosen indices to the top expresses
    any active selection.

    Args:
        struct_dict: ``{index: (symbol, (x, y, z))}`` in angstrom.
        active_atom_inds: indices (keys of ``struct_dict``) to promote.
    """
    unknown = [i for i in active_atom_inds if i not in struct_dict]
    if unknown:
        raise ValueError(
            f"Active atom indices {unknown} do not exist in the structure "
            f"(valid indices: {sorted(struct_dict)})."
        )
    active = list(active_atom_inds)
    environment = [i for i in struct_dict if i not in set(active)]
    lines = [str(len(struct_dict)), " "]
    for idx in active + environment:
        symbol, (x, y, z) = struct_dict[idx]
        lines.append(f"{symbol}\t{x}\t{y}\t{z}")
    return "\n".join(lines) + "\n"


def save_ordered_xyz_file(file_name: str, struct_dict: dict, active_atom_inds: list,
                          save_location: Optional[Path] = None) -> Path:
    """Write the ordered XYZ to ``<save_location>/molecular_structures/
    <file_name>.xyz`` (the directory made as needed; the working directory
    by default) and return its path."""
    base = Path(save_location) if save_location is not None else Path.cwd()
    out_dir = base / "molecular_structures"
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{file_name}.xyz"
    out_path.write_text(build_ordered_xyz_string(struct_dict, active_atom_inds))
    return out_path
