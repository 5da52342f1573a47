# Convenience targets. The Python package needs no build; the native oracle
# builds itself on first use (phys_autodiff_tpu/ref/native.py), or:
.PHONY: native test bench smoke clean

native:
	mkdir -p build
	g++ -O3 -std=c++17 -shared -fPIC csrc/physd_oracle.cpp -o build/libphysd_oracle.so

test:
	python -m pytest tests/ -q

# both need an NVIDIA GPU and refuse to run anywhere else
bench:
	PYTHONPATH=.:$$PYTHONPATH python bench.py

smoke:
	PYTHONPATH=.:$$PYTHONPATH python chip_smoke.py

clean:
	rm -rf build
