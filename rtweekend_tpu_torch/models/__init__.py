"""Scene representation and the registry scene builders."""
