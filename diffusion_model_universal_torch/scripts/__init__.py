"""CLIs of the port: ``generate`` and the HTTP sampling ``serve``r."""
