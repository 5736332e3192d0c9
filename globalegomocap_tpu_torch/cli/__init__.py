"""Command-line entry points: optimize / serve / evaluate_all / train /
preprocess / introspect."""
