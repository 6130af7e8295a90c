"""Inputs builders that a configuration names: ``"inputs": "<name>"`` in a
configuration file selects ``benchmark/inputs/<name>.py``, whose
``make_inputs(config)`` returns a ``benchmark.lib.inputs.Inputs`` made from
frozen copies (``benchmark/frozen``).  Without the key the configuration
uses ``benchmark.lib.inputs.make_inputs``.
"""
