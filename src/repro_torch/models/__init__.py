"""The dense transformer family (`transformer`), its layers (`layers`,
`mixers`) and the architecture config (`config`)."""
