"""One module per public entry of the program, found by the name a mix's
``entry`` gives (``generator.driver_class``); each holds a class ``Entry``
(see ``generator.py`` for what it has)."""
