"""The harness's side of the program under test: the model configuration
the program runs, built from a configuration file's ``port`` fields.  The
only module of ``harness`` that imports the program."""
from __future__ import annotations

import dataclasses


def port_config(cell, smoke: bool):
    """The program's model configuration as the configuration file runs
    it: the port's registered arch with the file's ``port`` fields."""
    from repro_torch import configs
    port = cell.config["port"]
    fields = dict(port["fields"])
    if smoke:
        fields.update(cell.config["smoke"]["port"])
    return dataclasses.replace(configs.get(port["arch"]), **fields)
