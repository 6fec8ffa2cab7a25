"""Analysis algorithms on the relation engine, and the scalar fields they
run on."""
